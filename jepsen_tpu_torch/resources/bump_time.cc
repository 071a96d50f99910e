// bump_time: jump the wall clock by a signed delta (milliseconds).
//
// Role parity with the reference's one-shot clock bumper
// (jepsen/resources/bump-time.c:13-52): read delta from argv, add it to
// gettimeofday, settimeofday the result. Compiled ON the target node by
// the clock nemesis (nemesis_time.py), as the reference compiles its C
// tools via gcc at setup time (jepsen/src/jepsen/nemesis/time.clj:14-41).
//
// --print-only computes and prints the target time without setting it
// (used by the framework's own tests, which must not skew their host).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/time.h>

int main(int argc, char **argv) {
  bool print_only = false;
  const char *delta_arg = nullptr;
  for (int i = 1; i < argc; i++) {
    if (!strcmp(argv[i], "--print-only")) {
      print_only = true;
    } else {
      delta_arg = argv[i];
    }
  }
  if (!delta_arg) {
    fprintf(stderr, "usage: bump_time [--print-only] <delta-ms>\n");
    return 2;
  }
  long long delta_ms = atoll(delta_arg);

  struct timeval tv;
  if (gettimeofday(&tv, nullptr) != 0) {
    perror("gettimeofday");
    return 1;
  }
  long long usec = (long long)tv.tv_sec * 1000000LL + tv.tv_usec +
                   delta_ms * 1000LL;
  struct timeval target;
  target.tv_sec = usec / 1000000LL;
  target.tv_usec = usec % 1000000LL;
  if (target.tv_usec < 0) {
    target.tv_sec -= 1;
    target.tv_usec += 1000000LL;
  }
  if (print_only) {
    printf("%lld.%06lld\n", (long long)target.tv_sec,
           (long long)target.tv_usec);
    return 0;
  }
  if (settimeofday(&target, nullptr) != 0) {
    perror("settimeofday");
    return 1;
  }
  printf("%lld\n", (long long)target.tv_sec);
  return 0;
}
