"""The plain reference that decides `correct`.

Plain PyTorch, float32 with TF32 off unless a control asks for a lower
precision. It imports nothing of the program (`vstab_torch`), of JAX or of
the JAX package: the plain versions it needs are frozen copies here, and it
works out again from the raw inputs (frames, checkpoint tensors, scenes, the
generator's seed) everything the program derives from them.
"""
