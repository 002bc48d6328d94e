"""Host-exact building blocks, copied from the reference package: prime
fields, keccak-256, error types."""
