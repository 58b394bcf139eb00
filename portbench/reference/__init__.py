"""The plain reference of the GFNet matcher, in PyTorch, float32, TF32 off.

A frozen copy of the model's mathematics as the port computes it, with its
hand-written kernels replaced by plain operations (attention as two
products and a softmax, local correlation as a gather of patches) and no
training path, mesh or batching tricks. It imports nothing of the port or of
the JAX package: the benchmark hands it the same weights and inputs as the
program, and it works out everything else again, the keys and their draws
included. `numerics.lowered()` runs it one step of precision lower, as the
control of the benchmark's `correct`.
"""
