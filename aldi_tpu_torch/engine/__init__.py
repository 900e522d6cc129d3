"""Serving export and weight conversion of the port."""
