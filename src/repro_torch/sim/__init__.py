"""Trace-driven evaluation of the port's coded memory system: seeded
synthetic traces (``trace``) and the per-point driver (``ramulator``)."""
