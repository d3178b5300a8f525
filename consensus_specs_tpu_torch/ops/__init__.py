"""Device kernels: SHA-256 for SSZ Merkleization (`sha256`), built from
`csrc/` by `sha256_cuda`, with plain PyTorch versions in `sha256_plain`."""
