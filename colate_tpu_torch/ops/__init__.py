"""Device programs of the port: the EM in torch and its CUDA kernel."""
