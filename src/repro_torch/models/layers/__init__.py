"""Layers as plain functions over tensors and explicit params."""
