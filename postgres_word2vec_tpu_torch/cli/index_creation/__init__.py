"""Offline index construction (``index_creation/*.py``): embedding file →
store, PQ / IVFADC / IVPQ builds, re-import checks, FREDDY dump
migration and ``.bin`` → text conversion."""
