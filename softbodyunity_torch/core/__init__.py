"""Configuration, topology and state of the port."""
