"""Plain torch and CUDA-kernel operations of the port."""
