"""The frozen copy of the port's ECS systems (see `benchmark/reference/engine_frame.py`)."""
