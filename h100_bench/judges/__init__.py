"""The comparison that decides ``correct``, one file a traffic kind (judge.py)."""
