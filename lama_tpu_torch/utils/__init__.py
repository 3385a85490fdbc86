"""Host-side helpers of the port (copies of parts of lama_tpu.utils)."""
