"""The benchmark's plain reference: ``flow2d`` (plain PyTorch; imports
nothing of the program under test)."""
