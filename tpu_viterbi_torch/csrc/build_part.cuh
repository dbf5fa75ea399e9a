// Build parts: library.load_library compiles a source once per part, all
// started together, with -DBUILD_PART=<i> for each i below the count on its
// "// nvcc parts: N" line, so that ptxas runs the parts on separate cores.
// IN_PART(i) holds part i's code.  Built by hand without the macro, one
// object holds every part.
#pragma once

#ifdef BUILD_PART
#define IN_PART(i) (BUILD_PART == (i))
#else
#define IN_PART(i) 1
#endif
