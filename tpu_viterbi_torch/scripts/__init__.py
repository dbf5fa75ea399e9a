"""Measurement scripts of the port, run as ``python -m
tpu_viterbi_torch.scripts.<name>`` on a CUDA GPU."""
