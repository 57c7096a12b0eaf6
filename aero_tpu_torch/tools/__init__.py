"""Command-line tools of the port, run as `python -m aero_tpu_torch.tools.<name>`:
`generate_proof`, `stark_parser`, `demo`, `check_constraints` and
`regen_dryrun_golden`. They run on the CUDA card unless `--cpu` is given."""
