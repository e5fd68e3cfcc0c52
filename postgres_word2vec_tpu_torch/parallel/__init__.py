"""Row sharding of the engine's tables over a mesh of devices
(``sharding``)."""
