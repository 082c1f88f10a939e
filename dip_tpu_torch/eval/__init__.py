"""Evaluation harnesses: the SR table protocol."""
