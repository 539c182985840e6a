"""Plain references the correctness checks compare the program with."""
