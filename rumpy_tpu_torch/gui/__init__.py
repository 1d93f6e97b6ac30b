"""The GUI backend: ``server.py`` and its browser page ``index.html``."""
