"""Cryptographic primitives: SHA-256 hashing (see ssz.hashing / ops.sha256)
and BLS12-381 signatures (crypto.bls)."""
