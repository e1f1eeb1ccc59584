"""Serving subsystem of the port: the paged, chunked ``ServingEngine``."""
