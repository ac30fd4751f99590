"""Incubating ops of the port: the serving functionals (``incubate.nn``)
and the optimizer wrappers (``incubate.optimizer``)."""
