"""The offline eval and analysis scripts of the port, each run as
``python -m bsi_torch.scripts.<name>`` with the flags and output format of
the JAX package's ``scripts/<name>.py``: ``eval_elbo``, ``eval_fid``,
``generate_samples``, ``generate_sample_history``, ``sample_h_alpha``,
``compute_fid_stats``, ``eval_overrides`` and ``render_samples``."""
