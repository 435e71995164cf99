"""The plain reference: float64 PyTorch, computed in blocks, independent of
the program under test (it imports nothing of it, nor jax, nor the JAX
package). It reads the program's outputs only to judge them."""
