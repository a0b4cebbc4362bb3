"""Analyses: the solid reaction solve."""
