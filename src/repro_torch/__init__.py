"""PyTorch/CUDA port of the EC-DNN serving path (see README: PyTorch/CUDA port)."""
