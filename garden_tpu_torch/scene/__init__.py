"""Scene serialization: the resource/scene pipeline (reference layer 6)."""
