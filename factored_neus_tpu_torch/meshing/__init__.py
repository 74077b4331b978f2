"""Mesh extraction of the port: grid fill, marching tetrahedra, PLY."""
