"""Degradation pipeline ops (the device paths) and ``ImagePipeline``."""
