"""Traffic drivers, one module per kind, named by a traffic file's
``driver``."""
