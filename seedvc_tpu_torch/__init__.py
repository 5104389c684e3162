"""PyTorch/CUDA port of seedvc_tpu for NVIDIA Hopper GPUs."""
