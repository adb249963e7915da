"""The drivers of each traffic kind, one file a kind (systems.py)."""
