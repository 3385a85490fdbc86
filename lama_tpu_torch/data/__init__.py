"""Host-side data for the port's CLIs: image I/O and the evaluation
datasets (copies of the parts of lama_tpu.data they use)."""
