"""Host-side resiliency primitives of the port (numpy)."""
