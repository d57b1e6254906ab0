"""Configurations and backend settings."""
