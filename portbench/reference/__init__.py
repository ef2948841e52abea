"""The plain PyTorch reference of the benchmark's configurations: float32
nets, losses, pools and Adam, importing nothing of the program."""
