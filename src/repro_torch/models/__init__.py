"""The LM substrate in plain PyTorch (ROADMAP A13): the serving path of
the dense decoder and mixture-of-experts families."""
