"""Evaluation-time procedures of the port (counterpart of
lama_tpu.evaluation); this slice ports the multiscale refiner."""
