"""A frozen copy of the plain path of ``elmkernels_torch`` (see the
package above); the modules keep their names and docstrings."""
