"""Command-line tools of the port, run as `python -m aero_tpu_torch.tools.<name>`:
`generate_proof`, `stark_parser` and `demo`. They prove on the CUDA card
unless `--cpu` is given."""
