"""The benchmark's model builders: the port's factory for a config's ``model``."""
