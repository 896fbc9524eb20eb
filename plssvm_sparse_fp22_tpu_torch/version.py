"""Version information.

TPU-native re-implementation of the capabilities of PLSSVM v1.2.0
(reference: ``CMakeLists.txt:9-12``, ``include/plssvm/version/version.hpp.in``).
"""

NAME = "PLSSVM-TPU"
VERSION_MAJOR = 1
VERSION_MINOR = 2
VERSION_PATCH = 0
VERSION = f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_PATCH}"
