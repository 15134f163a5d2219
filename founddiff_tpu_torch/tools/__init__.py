"""Command-line tools of the port (``python -m founddiff_tpu_torch.tools.<name>``)."""
