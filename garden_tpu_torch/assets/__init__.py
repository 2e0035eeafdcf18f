"""Asset pipeline: pack archives, model/image loading (reference layer 6)."""
