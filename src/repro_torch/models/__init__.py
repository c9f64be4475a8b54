"""The LM substrate in plain PyTorch (ROADMAP A13): the serving path of
every family of the JAX package's ``repro.models`` (dense decoder, VLM,
mixture-of-experts, ssm, hybrid and encoder-decoder)."""
