"""Host-side conversions and scalar field helpers."""
