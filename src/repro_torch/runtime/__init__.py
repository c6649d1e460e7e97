"""Serving runtime: coded KV page pool, steps, server."""
