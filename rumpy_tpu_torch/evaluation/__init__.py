"""Evaluation of trained models: ``EvalHub``."""
