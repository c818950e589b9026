"""Runnable twins of the repository's example scripts, driving the port
end to end: `python -m repro_torch.examples.quickstart [--device cpu]`,
`python -m repro_torch.examples.datacenter_sim [--device cpu]`,
`python -m repro_torch.examples.train_lm [--device cpu]` and
`python -m repro_torch.examples.serve_capped [--device cpu]`."""
