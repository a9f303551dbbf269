"""The H100 benchmark of convdr_torch: see README.md."""
