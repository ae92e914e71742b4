"""Plain references of the port-only models: straightforward PyTorch in
float32 with TF32 off, importing nothing of the port and nothing of JAX,
for the tests that hold the port's spec-driven network to them."""
