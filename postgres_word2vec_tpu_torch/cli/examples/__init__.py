"""The walkthroughs of ``examples/``: quickstart, serving and the mesh."""
