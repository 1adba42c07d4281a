"""Serving engine, request model and trace generators."""
