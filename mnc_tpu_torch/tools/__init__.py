"""Entry points of the port (``python3 -m mnc_tpu_torch.tools.<name>``)."""
