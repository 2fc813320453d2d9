"""Failure diagnosis: the port of the reference's diagnosis actions and
diagnosticians the launcher needs."""
