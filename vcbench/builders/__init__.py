"""Builders: one file a kind of configuration, named by a configuration file."""
