"""The plain float32 reference that ``portbench/check.py`` holds the port against."""
