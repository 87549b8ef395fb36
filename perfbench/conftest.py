import os
import sys

# the port under test lives in <checkout>/src
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
if SRC not in map(os.path.abspath, sys.path):
    sys.path.insert(0, SRC)
