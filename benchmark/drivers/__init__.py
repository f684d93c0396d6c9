"""The window loops, one module a driver named by a cell's file."""
