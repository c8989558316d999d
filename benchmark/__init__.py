"""The benchmark of the pupiloptixlab_tpu_torch port (run.py runs one cell)."""
