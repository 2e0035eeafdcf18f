"""Aux subsystems: profiling, checkpointing, debug guards."""
