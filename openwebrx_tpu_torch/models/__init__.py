"""Stages and receiver chains built from the ops."""
