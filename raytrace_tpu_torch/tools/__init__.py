"""Host tools: the reference's ChaCha20 host RNG (``chacha``) and the
final-one-weekend scene generator (``generate``)."""

from .generate import (generate_final_one_weekend_pair,
                       generate_final_one_weekend_scene)

__all__ = ["generate_final_one_weekend_pair",
           "generate_final_one_weekend_scene"]
