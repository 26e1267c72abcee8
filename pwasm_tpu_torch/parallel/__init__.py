"""Host-side batching policy of the port."""
