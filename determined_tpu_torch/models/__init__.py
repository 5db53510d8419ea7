"""Model definitions in PyTorch, in the JAX package's layouts: GPT-2
(dense and MoE), and the convolutional models (MNIST, ResNet, the DDPM
diffusion UNet), whose kernels are OIHW (`models/_conv.py` converts)."""
