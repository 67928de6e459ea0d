"""Host-side helpers of the port (numpy only)."""
