"""Plain PyTorch references that decide a cell's ``correct``: each model's
math (``bde2vid``, ``e2vid``), the voxel grids (``events``) and the scores
(``scores``). None of them imports the program under test."""
