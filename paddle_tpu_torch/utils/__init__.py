"""Host-side helpers of the port (building the native libraries)."""
