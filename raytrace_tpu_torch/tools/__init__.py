"""Host tools: the reference's ChaCha20 host RNG (``chacha``)."""
