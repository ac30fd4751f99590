"""Incubating serving ops of the port."""
