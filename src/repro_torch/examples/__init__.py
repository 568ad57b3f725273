"""The reference's four examples on the port, each run as
``python -m repro_torch.examples.<name>``: ``quickstart``,
``serve_stream``, ``train_small`` and ``multi_pod_dryrun``."""
