"""Host-side utilities: image IO and colour conversion (``image``)."""
