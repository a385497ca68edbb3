"""Command-line drivers of the port (``python -m
decentralized_ekf_mhe_tpu_torch.examples.<name>``): ``run_go1`` (the Go1
pipeline, synthetic or recorded log), ``run_robot`` (Go1, Cassie, PogoX,
optionally with a velocity box) and ``run_hil`` (the streaming EKF+MHE
cycle). Each runs on the card unless given ``--cpu``."""
