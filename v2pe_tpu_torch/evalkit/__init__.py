"""Evaluation harness of the port: the MM-NIAH-long teacher-forced eval."""
