"""The plain reference of the benchmark's jobs and the comparison that
decides ``correct``; imports nothing of the program."""
