"""Host-side video I/O of the port."""
