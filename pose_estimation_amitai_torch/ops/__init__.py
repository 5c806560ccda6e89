"""Tensor ops of the PyTorch port: peak decode, geometry, and the Hopper
kernels (``hopper_conv``, ``hopper_deconv``) with their plain versions."""
