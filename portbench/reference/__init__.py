"""Plain PyTorch references, one module a task.  They take the generated
tensors only and import nothing of the port, of JAX or of its package."""
