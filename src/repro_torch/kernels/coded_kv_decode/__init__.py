"""Serving pool gather (coded KV decode datapath)."""
