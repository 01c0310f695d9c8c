"""Plain float32 PyTorch forwards of the benchmark's models, written from the
published architectures. They import nothing of the port or of the JAX
package, and take only tensors the benchmark made from the seed."""
