"""Numerical core of the port: precision policy, ordered float32
arithmetic, features, clustering and sampling."""
