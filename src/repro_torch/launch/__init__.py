"""Entry points of the port: serving, and the prefill and decode steps it runs."""
