"""Model configurations of the port (own copies of ``repro.configs``)."""
