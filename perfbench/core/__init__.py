"""The benchmark's yardstick: IR reading, seeded weights and traffic, the
plain reference's walk, the trace's reduction, work counts and peaks.
Only ``system.py`` imports the program under test."""
