"""Multi-rank solves on torch.distributed (port of visual_slam_tpu/parallel)."""
