"""Command-line tools of the port, run as `python -m aero_tpu_torch.tools.<name>`:
`generate_proof`, `stark_parser`, `demo`, `check_constraints`,
`regen_dryrun_golden` and `card_check`. They run on the CUDA card unless
`--cpu` is given; `card_check` checks the built kernels and has no `--cpu`."""
