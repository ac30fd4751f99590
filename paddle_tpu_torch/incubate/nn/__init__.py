"""Incubating nn ops of the port."""
