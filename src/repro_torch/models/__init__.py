"""Model stack of the port: ``layers``, ``frontends``, ``transformer``."""
