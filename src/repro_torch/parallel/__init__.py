"""Parallel runtime of the port (see ``collectives``)."""
