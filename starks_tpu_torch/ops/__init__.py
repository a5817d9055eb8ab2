"""Field tensors, CUDA kernel wrappers, hashing, trees and FRI."""
