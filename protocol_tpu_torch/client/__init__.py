"""Client-side attestation codecs and the batched ingest path."""
