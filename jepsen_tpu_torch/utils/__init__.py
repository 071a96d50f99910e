"""Host-side helpers (copies of what the port needs from
jepsen_tpu.utils)."""
