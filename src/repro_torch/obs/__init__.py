"""Host-side observability of the serving path."""
