// fusefaultfs — mount-level fault-injecting passthrough filesystem.
//
// The charybdefs role (reference: charybdefs/, driven by
// charybdefs/src/jepsen/charybdefs.clj:40-85): a FUSE filesystem
// mounted over a database's data directory that can be told, at
// runtime, to fail operations — EIO on everything, probabilistic
// faults, per-class (read/write) faults, extra latency. Because the
// interception happens at the VFS mount, it afflicts ANY process,
// including statically-linked Go binaries (etcd, consul) that an
// LD_PRELOAD interposer (resources/faultfs.cc) cannot touch.
//
// No libfuse exists in this image, so this speaks the raw kernel FUSE
// protocol over /dev/fuse directly (<linux/fuse.h>): INIT handshake,
// then a single-threaded request loop dispatching LOOKUP/GETATTR/
// OPEN/READ/WRITE/... as *at syscalls against O_PATH inode fds (the
// proc-self-fd reopen idiom), replying with fuse_out_header frames.
// Single-threaded is deliberate: this filesystem hosts fault-injection
// tests, not production IO, and one loop keeps fault ordering exact.
//
// Control channel: the magic file ".faultfs-ctl" at the mount root
// (the Thrift server role in charybdefs). Writing text commands
// configures faults; reading it returns the current state. It works
// from any shell —
//   echo "break all"      > mnt/.faultfs-ctl   # EIO every op
//   echo "flaky all 100"  > mnt/.faultfs-ctl   # 1% of ops fail EIO
//   echo "clear"          > mnt/.faultfs-ctl
// which makes remote driving via the control plane trivial (session
// .exec echo), with no RPC stack to install — the reference needs a
// full Thrift build from source (charybdefs.clj:7-38).
//
// Usage: fusefaultfs <backing_dir> <mountpoint> [--foreground]

#include <linux/fuse.h>

#include <dirent.h>
#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mount.h>
#include <sys/stat.h>
#include <sys/statvfs.h>
#include <sys/time.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <unistd.h>

#include <cstdint>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Fault state (the charybdefs fault API surface: set_all_fault,
// probabilistic faults, clear_all_faults — charybdefs.clj:67-85).

enum OpClass : unsigned { OC_READ = 1, OC_WRITE = 2, OC_META = 4 };

struct FaultState {
  unsigned classes = 0;    // OpClass bits currently afflicted
  int err = EIO;           // errno injected
  int prob_bp = 10000;     // probability in basis points (10000 = always)
  long delay_us = 0;       // extra latency before the op
  std::string filter;      // substring of the node name ("" = all)
} g_fault;

std::mt19937_64 g_rng(0xfa017f5ULL ^ 0x9e3779b97f4a7c15ULL);

bool fault_hits(unsigned op_class, const std::string& name) {
  if (!(g_fault.classes & op_class)) return false;
  if (!g_fault.filter.empty() &&
      name.find(g_fault.filter) == std::string::npos)
    return false;
  if (g_fault.delay_us > 0) usleep(g_fault.delay_us);
  if (g_fault.prob_bp >= 10000) return true;
  return (long)(g_rng() % 10000) < g_fault.prob_bp;
}

const char kCtlName[] = ".faultfs-ctl";
constexpr uint64_t kCtlNode = ~0ULL - 1;  // sentinel nodeid
constexpr uint64_t kCtlFh = ~0ULL - 1;    // sentinel file handle

std::string ctl_status() {
  char buf[256];
  snprintf(buf, sizeof buf,
           "classes=%s%s%s err=%d prob_bp=%d delay_us=%ld filter=%s\n",
           (g_fault.classes & OC_READ) ? "r" : "",
           (g_fault.classes & OC_WRITE) ? "w" : "",
           (g_fault.classes & OC_META) ? "m" : "",
           g_fault.err, g_fault.prob_bp, g_fault.delay_us,
           g_fault.filter.empty() ? "-" : g_fault.filter.c_str());
  return buf;
}

unsigned parse_classes(const std::string& word) {
  if (word == "all") return OC_READ | OC_WRITE | OC_META;
  if (word == "read") return OC_READ;
  if (word == "write") return OC_WRITE;
  if (word == "meta") return OC_META;
  return 0;
}

// Commands: clear | break <class> [errno N] | flaky <class> <bp>
// [errno N] | delay <class> <us> | filter <substr|->
void ctl_command(const std::string& line) {
  std::vector<std::string> w;
  size_t i = 0;
  while (i < line.size()) {
    size_t j = line.find_first_of(" \t\n", i);
    if (j == std::string::npos) j = line.size();
    if (j > i) w.push_back(line.substr(i, j - i));
    i = j + 1;
  }
  if (w.empty()) return;
  if (w[0] == "clear") {
    g_fault = FaultState{};
    g_fault.classes = 0;
    return;
  }
  if (w[0] == "filter" && w.size() >= 2) {
    g_fault.filter = (w[1] == "-") ? "" : w[1];
    return;
  }
  if (w.size() >= 2) {
    unsigned cls = parse_classes(w[1]);
    if (w[0] == "break") {
      g_fault.classes = cls;
      g_fault.prob_bp = 10000;
      g_fault.delay_us = 0;
      g_fault.err = EIO;
      if (w.size() >= 4 && w[2] == "errno") g_fault.err = atoi(w[3].c_str());
    } else if (w[0] == "flaky" && w.size() >= 3) {
      g_fault.classes = cls;
      g_fault.prob_bp = atoi(w[2].c_str());
      g_fault.err = EIO;
      if (w.size() >= 5 && w[3] == "errno") g_fault.err = atoi(w[4].c_str());
    } else if (w[0] == "delay" && w.size() >= 3) {
      g_fault.classes = cls;
      g_fault.prob_bp = 10000;
      g_fault.delay_us = atol(w[2].c_str());
      g_fault.err = 0;  // delay-only: never actually fail
    }
  }
}

// ---------------------------------------------------------------------------
// Inode table: nodeid -> O_PATH fd (+ name for fault filters), deduped
// by (dev, ino) so hardlinks and repeat lookups share a nodeid.

struct Inode {
  int path_fd = -1;       // O_PATH handle — survives renames
  uint64_t nlookup = 0;
  std::string name;       // last component, for fault filtering
  uint64_t dev = 0, ino = 0;
};

std::unordered_map<uint64_t, Inode> g_inodes;

// Dedup by the ACTUAL (dev, ino) pair — folding the pair into one
// 64-bit hash would alias two distinct inodes on collision (wrong
// attrs/fds, and forget erasing the survivor's mapping); the hash is
// only the bucket function, equality is exact.
struct DevIno {
  uint64_t dev, ino;
  bool operator==(const DevIno& o) const {
    return dev == o.dev && ino == o.ino;
  }
};
struct DevInoHash {
  size_t operator()(const DevIno& k) const {
    return (size_t)(k.dev * 0x100000001b3ULL ^ k.ino);
  }
};
std::unordered_map<DevIno, uint64_t, DevInoHash> g_by_devino;
uint64_t g_next_node = 2;  // 1 is the root

DevIno devino_key(uint64_t dev, uint64_t ino) {
  return DevIno{dev, ino};
}

// Open file handles (fh -> real fd / DIR*).
struct FileHandle {
  int fd;
  bool writable;  // FLUSH faults only write-capable handles
};
std::unordered_map<uint64_t, FileHandle> g_files;
std::unordered_map<uint64_t, DIR*> g_dirs;
uint64_t g_next_fh = 1;

int g_fuse_fd = -1;
std::string g_mountpoint;
bool g_running = true;

std::string proc_path(int fd) {
  char buf[64];
  snprintf(buf, sizeof buf, "/proc/self/fd/%d", fd);
  return buf;
}

void stat_to_attr(const struct stat& st, struct fuse_attr* a) {
  memset(a, 0, sizeof *a);
  a->ino = st.st_ino;
  a->size = st.st_size;
  a->blocks = st.st_blocks;
  a->atime = st.st_atim.tv_sec;
  a->mtime = st.st_mtim.tv_sec;
  a->ctime = st.st_ctim.tv_sec;
  a->atimensec = st.st_atim.tv_nsec;
  a->mtimensec = st.st_mtim.tv_nsec;
  a->ctimensec = st.st_ctim.tv_nsec;
  a->mode = st.st_mode;
  a->nlink = st.st_nlink;
  a->uid = st.st_uid;
  a->gid = st.st_gid;
  a->rdev = st.st_rdev;
  a->blksize = st.st_blksize;
}

// ---------------------------------------------------------------------------
// Reply plumbing.

void reply_raw(uint64_t unique, int error, const void* data, size_t n) {
  struct fuse_out_header out;
  out.len = sizeof out + n;
  out.error = error;
  out.unique = unique;
  struct iovec iov[2] = {
      {&out, sizeof out},
      {const_cast<void*>(data), n},
  };
  ssize_t r = writev(g_fuse_fd, iov, data ? 2 : 1);
  (void)r;
}

void reply_err(uint64_t unique, int err) { reply_raw(unique, -err, nullptr, 0); }

void reply_ok(uint64_t unique, const void* data, size_t n) {
  reply_raw(unique, 0, data, n);
}

bool fill_entry(int parent_path_fd, const char* name,
                struct fuse_entry_out* e) {
  int fd = openat(parent_path_fd, name,
                  O_PATH | O_NOFOLLOW | O_CLOEXEC);
  if (fd < 0) return false;
  struct stat st;
  if (fstatat(fd, "", &st, AT_EMPTY_PATH) < 0) {
    close(fd);
    return false;
  }
  DevIno key = devino_key(st.st_dev, st.st_ino);
  auto it = g_by_devino.find(key);
  uint64_t node;
  if (it != g_by_devino.end() && g_inodes.count(it->second)) {
    node = it->second;
    close(fd);  // already have a path fd for this inode
  } else {
    node = g_next_node++;
    Inode ino;
    ino.path_fd = fd;
    ino.name = name;
    ino.dev = st.st_dev;
    ino.ino = st.st_ino;
    g_inodes[node] = ino;
    g_by_devino[key] = node;
  }
  g_inodes[node].nlookup++;
  memset(e, 0, sizeof *e);
  e->nodeid = node;
  e->attr_valid = 1;
  e->entry_valid = 1;
  stat_to_attr(st, &e->attr);
  return true;
}

Inode* get_inode(uint64_t nodeid) {
  auto it = g_inodes.find(nodeid);
  return it == g_inodes.end() ? nullptr : &it->second;
}

// ---------------------------------------------------------------------------
// Opcode handlers. `in` points at the opcode-specific payload.

void do_init(const fuse_in_header* h, const void* in) {
  auto* i = static_cast<const fuse_init_in*>(in);
  struct fuse_init_out out;
  memset(&out, 0, sizeof out);
  out.major = FUSE_KERNEL_VERSION;
  out.minor = FUSE_KERNEL_MINOR_VERSION < i->minor
                  ? FUSE_KERNEL_MINOR_VERSION
                  : i->minor;
  out.max_readahead = i->max_readahead;
  out.flags = 0;  // no fancy features: plain request/reply
  out.max_write = 1 << 20;
  out.max_background = 16;
  out.congestion_threshold = 12;
  // Kernels older than our minor still accept the full struct.
  reply_ok(h->unique, &out, sizeof out);
}

void do_lookup(const fuse_in_header* h, const void* in) {
  const char* name = static_cast<const char*>(in);
  Inode* parent = get_inode(h->nodeid);
  if (!parent) return reply_err(h->unique, ENOENT);
  if (h->nodeid == FUSE_ROOT_ID && !strcmp(name, kCtlName)) {
    struct fuse_entry_out e;
    memset(&e, 0, sizeof e);
    e.nodeid = kCtlNode;
    e.attr.ino = kCtlNode;
    e.attr.mode = S_IFREG | 0666;
    e.attr.nlink = 1;
    e.attr.size = 4096;
    e.attr_valid = 0;  // always re-stat: size is synthetic
    return reply_ok(h->unique, &e, sizeof e);
  }
  if (fault_hits(OC_META, name)) return reply_err(h->unique, g_fault.err);
  struct fuse_entry_out e;
  if (!fill_entry(parent->path_fd, name, &e))
    return reply_err(h->unique, errno ? errno : ENOENT);
  reply_ok(h->unique, &e, sizeof e);
}

void do_forget_one(uint64_t nodeid, uint64_t n) {
  Inode* ino = get_inode(nodeid);
  if (!ino) return;
  if (ino->nlookup <= n) {
    g_by_devino.erase(devino_key(ino->dev, ino->ino));
    close(ino->path_fd);
    g_inodes.erase(nodeid);
  } else {
    ino->nlookup -= n;
  }
}

void do_getattr(const fuse_in_header* h, const void*) {
  if (h->nodeid == kCtlNode) {
    struct fuse_attr_out out;
    memset(&out, 0, sizeof out);
    out.attr.ino = kCtlNode;
    out.attr.mode = S_IFREG | 0666;
    out.attr.nlink = 1;
    out.attr.size = ctl_status().size();
    return reply_ok(h->unique, &out, sizeof out);
  }
  Inode* ino = get_inode(h->nodeid);
  if (!ino) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_META, ino->name))
    return reply_err(h->unique, g_fault.err);
  struct stat st;
  if (fstatat(ino->path_fd, "", &st, AT_EMPTY_PATH) < 0)
    return reply_err(h->unique, errno);
  struct fuse_attr_out out;
  memset(&out, 0, sizeof out);
  out.attr_valid = 1;
  stat_to_attr(st, &out.attr);
  reply_ok(h->unique, &out, sizeof out);
}

void do_setattr(const fuse_in_header* h, const void* in) {
  auto* s = static_cast<const fuse_setattr_in*>(in);
  if (h->nodeid == kCtlNode) {
    // O_TRUNC on the control file arrives as SETATTR size=0; accept
    // it so `echo cmd > mnt/.faultfs-ctl` works from any shell.
    struct fuse_attr_out out;
    memset(&out, 0, sizeof out);
    out.attr.ino = kCtlNode;
    out.attr.mode = S_IFREG | 0666;
    out.attr.nlink = 1;
    return reply_ok(h->unique, &out, sizeof out);
  }
  Inode* ino = get_inode(h->nodeid);
  if (!ino) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_WRITE, ino->name))
    return reply_err(h->unique, g_fault.err);
  std::string p = proc_path(ino->path_fd);
  if (s->valid & FATTR_MODE) {
    if (chmod(p.c_str(), s->mode) < 0) return reply_err(h->unique, errno);
  }
  if (s->valid & (FATTR_UID | FATTR_GID)) {
    uid_t u = (s->valid & FATTR_UID) ? s->uid : (uid_t)-1;
    gid_t g = (s->valid & FATTR_GID) ? s->gid : (gid_t)-1;
    if (chown(p.c_str(), u, g) < 0) return reply_err(h->unique, errno);
  }
  if (s->valid & FATTR_SIZE) {
    if (truncate(p.c_str(), s->size) < 0) return reply_err(h->unique, errno);
  }
  if (s->valid & (FATTR_ATIME | FATTR_MTIME)) {
    struct timespec ts[2];
    ts[0].tv_nsec = UTIME_OMIT;
    ts[1].tv_nsec = UTIME_OMIT;
    if (s->valid & FATTR_ATIME) {
      ts[0].tv_sec = s->atime;
      ts[0].tv_nsec = (s->valid & FATTR_ATIME_NOW) ? UTIME_NOW
                                                   : (long)s->atimensec;
    }
    if (s->valid & FATTR_MTIME) {
      ts[1].tv_sec = s->mtime;
      ts[1].tv_nsec = (s->valid & FATTR_MTIME_NOW) ? UTIME_NOW
                                                   : (long)s->mtimensec;
    }
    if (utimensat(AT_FDCWD, p.c_str(), ts, 0) < 0)
      return reply_err(h->unique, errno);
  }
  struct stat st;
  if (fstatat(ino->path_fd, "", &st, AT_EMPTY_PATH) < 0)
    return reply_err(h->unique, errno);
  struct fuse_attr_out out;
  memset(&out, 0, sizeof out);
  out.attr_valid = 1;
  stat_to_attr(st, &out.attr);
  reply_ok(h->unique, &out, sizeof out);
}

void do_open(const fuse_in_header* h, const void* in) {
  auto* o = static_cast<const fuse_open_in*>(in);
  if (h->nodeid == kCtlNode) {
    struct fuse_open_out out;
    memset(&out, 0, sizeof out);
    out.fh = kCtlFh;
    out.open_flags = FOPEN_DIRECT_IO;  // reads bypass page cache
    return reply_ok(h->unique, &out, sizeof out);
  }
  Inode* ino = get_inode(h->nodeid);
  if (!ino) return reply_err(h->unique, ENOENT);
  unsigned cls = ((o->flags & O_ACCMODE) == O_RDONLY) ? OC_READ : OC_WRITE;
  if (fault_hits(cls, ino->name))
    return reply_err(h->unique, g_fault.err);
  int fd = open(proc_path(ino->path_fd).c_str(),
                (o->flags & ~(O_NOFOLLOW | O_CREAT)) | O_CLOEXEC);
  if (fd < 0) return reply_err(h->unique, errno);
  struct fuse_open_out out;
  memset(&out, 0, sizeof out);
  out.fh = g_next_fh++;
  g_files[out.fh] = FileHandle{fd, (o->flags & O_ACCMODE) != O_RDONLY};
  reply_ok(h->unique, &out, sizeof out);
}

void do_create(const fuse_in_header* h, const void* in) {
  auto* c = static_cast<const fuse_create_in*>(in);
  const char* name =
      reinterpret_cast<const char*>(c + 1);
  Inode* parent = get_inode(h->nodeid);
  if (!parent) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_WRITE, name))
    return reply_err(h->unique, g_fault.err);
  int fd = openat(parent->path_fd, name,
                  (c->flags & ~O_NOFOLLOW) | O_CREAT | O_CLOEXEC,
                  c->mode);
  if (fd < 0) return reply_err(h->unique, errno);
  struct {
    struct fuse_entry_out e;
    struct fuse_open_out o;
  } out;
  memset(&out, 0, sizeof out);
  if (!fill_entry(parent->path_fd, name, &out.e)) {
    close(fd);
    return reply_err(h->unique, errno ? errno : EIO);
  }
  out.o.fh = g_next_fh++;
  g_files[out.o.fh] = FileHandle{fd, true};
  reply_ok(h->unique, &out, sizeof out);
}

void do_read(const fuse_in_header* h, const void* in) {
  auto* r = static_cast<const fuse_read_in*>(in);
  if (r->fh == kCtlFh) {
    std::string s = ctl_status();
    if ((size_t)r->offset >= s.size())
      return reply_ok(h->unique, nullptr, 0);
    size_t n = s.size() - r->offset;
    if (n > r->size) n = r->size;
    return reply_ok(h->unique, s.data() + r->offset, n);
  }
  auto it = g_files.find(r->fh);
  if (it == g_files.end()) return reply_err(h->unique, EBADF);
  Inode* ino = get_inode(h->nodeid);
  if (fault_hits(OC_READ, ino ? ino->name : ""))
    return reply_err(h->unique, g_fault.err);
  std::vector<char> buf(r->size);
  ssize_t n = pread(it->second.fd, buf.data(), r->size, r->offset);
  if (n < 0) return reply_err(h->unique, errno);
  reply_ok(h->unique, buf.data(), n);
}

void do_write(const fuse_in_header* h, const void* in) {
  auto* w = static_cast<const fuse_write_in*>(in);
  const char* data = reinterpret_cast<const char*>(w + 1);
  if (w->fh == kCtlFh) {
    ctl_command(std::string(data, w->size));
    struct fuse_write_out out;
    memset(&out, 0, sizeof out);
    out.size = w->size;
    return reply_ok(h->unique, &out, sizeof out);
  }
  auto it = g_files.find(w->fh);
  if (it == g_files.end()) return reply_err(h->unique, EBADF);
  Inode* ino = get_inode(h->nodeid);
  if (fault_hits(OC_WRITE, ino ? ino->name : ""))
    return reply_err(h->unique, g_fault.err);
  ssize_t n = pwrite(it->second.fd, data, w->size, w->offset);
  if (n < 0) return reply_err(h->unique, errno);
  struct fuse_write_out out;
  memset(&out, 0, sizeof out);
  out.size = n;
  reply_ok(h->unique, &out, sizeof out);
}

void do_release(const fuse_in_header* h, const void* in) {
  auto* r = static_cast<const fuse_release_in*>(in);
  if (r->fh != kCtlFh) {
    auto it = g_files.find(r->fh);
    if (it != g_files.end()) {
      close(it->second.fd);
      g_files.erase(it);
    }
  }
  reply_ok(h->unique, nullptr, 0);
}

void do_flush(const fuse_in_header* h, const void* in) {
  auto* f = static_cast<const fuse_flush_in*>(in);
  if (f->fh == kCtlFh) return reply_ok(h->unique, nullptr, 0);
  auto it = g_files.find(f->fh);
  // FLUSH is a write-class fault only on write-capable handles: a
  // read-only close must not trip write faults.
  if (it != g_files.end() && it->second.writable) {
    Inode* ino = get_inode(h->nodeid);
    if (fault_hits(OC_WRITE, ino ? ino->name : ""))
      return reply_err(h->unique, g_fault.err);
  }
  reply_ok(h->unique, nullptr, 0);
}

void do_fsync(const fuse_in_header* h, const void* in) {
  auto* f = static_cast<const fuse_fsync_in*>(in);
  auto it = g_files.find(f->fh);
  if (it == g_files.end()) return reply_err(h->unique, EBADF);
  Inode* ino = get_inode(h->nodeid);
  if (fault_hits(OC_WRITE, ino ? ino->name : ""))
    return reply_err(h->unique, g_fault.err);
  int rc = (f->fsync_flags & FUSE_FSYNC_FDATASYNC)
               ? fdatasync(it->second.fd)
               : fsync(it->second.fd);
  if (rc < 0) return reply_err(h->unique, errno);
  reply_ok(h->unique, nullptr, 0);
}

void do_mkdir(const fuse_in_header* h, const void* in) {
  auto* m = static_cast<const fuse_mkdir_in*>(in);
  const char* name = reinterpret_cast<const char*>(m + 1);
  Inode* parent = get_inode(h->nodeid);
  if (!parent) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_WRITE, name))
    return reply_err(h->unique, g_fault.err);
  if (mkdirat(parent->path_fd, name, m->mode) < 0)
    return reply_err(h->unique, errno);
  struct fuse_entry_out e;
  if (!fill_entry(parent->path_fd, name, &e))
    return reply_err(h->unique, errno ? errno : EIO);
  reply_ok(h->unique, &e, sizeof e);
}

void do_mknod(const fuse_in_header* h, const void* in) {
  auto* m = static_cast<const fuse_mknod_in*>(in);
  const char* name = reinterpret_cast<const char*>(m + 1);
  Inode* parent = get_inode(h->nodeid);
  if (!parent) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_WRITE, name))
    return reply_err(h->unique, g_fault.err);
  if (mknodat(parent->path_fd, name, m->mode, m->rdev) < 0)
    return reply_err(h->unique, errno);
  struct fuse_entry_out e;
  if (!fill_entry(parent->path_fd, name, &e))
    return reply_err(h->unique, errno ? errno : EIO);
  reply_ok(h->unique, &e, sizeof e);
}

void do_unlink(const fuse_in_header* h, const void* in, bool rmdir) {
  const char* name = static_cast<const char*>(in);
  Inode* parent = get_inode(h->nodeid);
  if (!parent) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_WRITE, name))
    return reply_err(h->unique, g_fault.err);
  if (unlinkat(parent->path_fd, name, rmdir ? AT_REMOVEDIR : 0) < 0)
    return reply_err(h->unique, errno);
  reply_ok(h->unique, nullptr, 0);
}

void do_rename(const fuse_in_header* h, const void* in, bool rename2) {
  uint64_t newdir;
  const char* oldname;
  if (rename2) {
    auto* r = static_cast<const fuse_rename2_in*>(in);
    if (r->flags) return reply_err(h->unique, EINVAL);
    newdir = r->newdir;
    oldname = reinterpret_cast<const char*>(r + 1);
  } else {
    auto* r = static_cast<const fuse_rename_in*>(in);
    newdir = r->newdir;
    oldname = reinterpret_cast<const char*>(r + 1);
  }
  const char* newname = oldname + strlen(oldname) + 1;
  Inode* po = get_inode(h->nodeid);
  Inode* pn = get_inode(newdir);
  if (!po || !pn) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_WRITE, oldname))
    return reply_err(h->unique, g_fault.err);
  if (renameat(po->path_fd, oldname, pn->path_fd, newname) < 0)
    return reply_err(h->unique, errno);
  reply_ok(h->unique, nullptr, 0);
}

void do_link(const fuse_in_header* h, const void* in) {
  auto* l = static_cast<const fuse_link_in*>(in);
  const char* name = reinterpret_cast<const char*>(l + 1);
  Inode* target = get_inode(l->oldnodeid);
  Inode* parent = get_inode(h->nodeid);
  if (!target || !parent) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_WRITE, name))
    return reply_err(h->unique, g_fault.err);
  if (linkat(AT_FDCWD, proc_path(target->path_fd).c_str(),
             parent->path_fd, name, AT_SYMLINK_FOLLOW) < 0)
    return reply_err(h->unique, errno);
  struct fuse_entry_out e;
  if (!fill_entry(parent->path_fd, name, &e))
    return reply_err(h->unique, errno ? errno : EIO);
  reply_ok(h->unique, &e, sizeof e);
}

void do_symlink(const fuse_in_header* h, const void* in) {
  const char* name = static_cast<const char*>(in);
  const char* target = name + strlen(name) + 1;
  Inode* parent = get_inode(h->nodeid);
  if (!parent) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_WRITE, name))
    return reply_err(h->unique, g_fault.err);
  if (symlinkat(target, parent->path_fd, name) < 0)
    return reply_err(h->unique, errno);
  struct fuse_entry_out e;
  if (!fill_entry(parent->path_fd, name, &e))
    return reply_err(h->unique, errno ? errno : EIO);
  reply_ok(h->unique, &e, sizeof e);
}

void do_readlink(const fuse_in_header* h, const void*) {
  Inode* ino = get_inode(h->nodeid);
  if (!ino) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_READ, ino->name))
    return reply_err(h->unique, g_fault.err);
  // readlinkat with an empty path reads the O_PATH symlink fd itself.
  char buf[4096];
  ssize_t n = readlinkat(ino->path_fd, "", buf, sizeof buf - 1);
  if (n < 0) return reply_err(h->unique, errno);
  reply_ok(h->unique, buf, n);
}

void do_opendir(const fuse_in_header* h, const void*) {
  Inode* ino = get_inode(h->nodeid);
  if (!ino) return reply_err(h->unique, ENOENT);
  if (fault_hits(OC_READ, ino->name))
    return reply_err(h->unique, g_fault.err);
  int fd = open(proc_path(ino->path_fd).c_str(),
                O_RDONLY | O_DIRECTORY | O_CLOEXEC);
  if (fd < 0) return reply_err(h->unique, errno);
  DIR* d = fdopendir(fd);
  if (!d) {
    close(fd);
    return reply_err(h->unique, errno);
  }
  struct fuse_open_out out;
  memset(&out, 0, sizeof out);
  out.fh = g_next_fh++;
  g_dirs[out.fh] = d;
  reply_ok(h->unique, &out, sizeof out);
}

void do_readdir(const fuse_in_header* h, const void* in) {
  auto* r = static_cast<const fuse_read_in*>(in);
  auto it = g_dirs.find(r->fh);
  if (it == g_dirs.end()) return reply_err(h->unique, EBADF);
  DIR* d = it->second;
  seekdir(d, r->offset);
  std::vector<char> buf;
  buf.reserve(r->size);
  while (buf.size() < r->size) {
    long off_before = telldir(d);
    errno = 0;
    struct dirent* de = readdir(d);
    if (!de) break;
    size_t namelen = strlen(de->d_name);
    size_t entlen = FUSE_NAME_OFFSET + namelen;
    size_t entlen_pad = FUSE_DIRENT_ALIGN(entlen);
    if (buf.size() + entlen_pad > r->size) {
      seekdir(d, off_before);
      break;
    }
    size_t base = buf.size();
    buf.resize(base + entlen_pad, 0);
    auto* fde = reinterpret_cast<struct fuse_dirent*>(buf.data() + base);
    fde->ino = de->d_ino;
    fde->off = telldir(d);
    fde->namelen = namelen;
    fde->type = de->d_type;
    memcpy(fde->name, de->d_name, namelen);
  }
  // The control file is lookup-only by design: it never appears in
  // readdir listings, so directory scans of the data dir stay clean.
  reply_ok(h->unique, buf.data(), buf.size());
}

void do_releasedir(const fuse_in_header* h, const void* in) {
  auto* r = static_cast<const fuse_release_in*>(in);
  auto it = g_dirs.find(r->fh);
  if (it != g_dirs.end()) {
    closedir(it->second);
    g_dirs.erase(it);
  }
  reply_ok(h->unique, nullptr, 0);
}

void do_statfs(const fuse_in_header* h) {
  Inode* ino = get_inode(h->nodeid);
  struct statvfs sv;
  if (fstatvfs(ino ? ino->path_fd : g_inodes[FUSE_ROOT_ID].path_fd,
               &sv) < 0)
    return reply_err(h->unique, errno);
  struct fuse_statfs_out out;
  memset(&out, 0, sizeof out);
  out.st.blocks = sv.f_blocks;
  out.st.bfree = sv.f_bfree;
  out.st.bavail = sv.f_bavail;
  out.st.files = sv.f_files;
  out.st.ffree = sv.f_ffree;
  out.st.bsize = sv.f_bsize;
  out.st.namelen = sv.f_namemax;
  out.st.frsize = sv.f_frsize;
  reply_ok(h->unique, &out, sizeof out);
}

void do_access(const fuse_in_header* h, const void* in) {
  auto* a = static_cast<const fuse_access_in*>(in);
  Inode* ino = get_inode(h->nodeid);
  if (!ino) return reply_err(h->unique, ENOENT);
  if (faccessat(AT_FDCWD, proc_path(ino->path_fd).c_str(), a->mask, 0) <
      0)
    return reply_err(h->unique, errno);
  reply_ok(h->unique, nullptr, 0);
}

void do_fallocate(const fuse_in_header* h, const void* in) {
  auto* f = static_cast<const fuse_fallocate_in*>(in);
  auto it = g_files.find(f->fh);
  if (it == g_files.end()) return reply_err(h->unique, EBADF);
  Inode* ino = get_inode(h->nodeid);
  if (fault_hits(OC_WRITE, ino ? ino->name : ""))
    return reply_err(h->unique, g_fault.err);
  if (fallocate(it->second.fd, f->mode, f->offset, f->length) < 0)
    return reply_err(h->unique, errno);
  reply_ok(h->unique, nullptr, 0);
}

void do_lseek(const fuse_in_header* h, const void* in) {
  auto* l = static_cast<const fuse_lseek_in*>(in);
  auto it = g_files.find(l->fh);
  if (it == g_files.end()) return reply_err(h->unique, EBADF);
  off_t off = lseek(it->second.fd, l->offset, l->whence);
  if (off < 0) return reply_err(h->unique, errno);
  struct fuse_lseek_out out;
  out.offset = off;
  reply_ok(h->unique, &out, sizeof out);
}

// ---------------------------------------------------------------------------

void handle(const fuse_in_header* h, const void* payload) {
  switch (h->opcode) {
    case FUSE_INIT: return do_init(h, payload);
    case FUSE_LOOKUP: return do_lookup(h, payload);
    case FUSE_FORGET:
      do_forget_one(
          h->nodeid,
          static_cast<const fuse_forget_in*>(payload)->nlookup);
      return;  // no reply
    case FUSE_BATCH_FORGET: {
      auto* b = static_cast<const fuse_batch_forget_in*>(payload);
      auto* items = reinterpret_cast<const fuse_forget_one*>(b + 1);
      for (uint32_t i = 0; i < b->count; i++)
        do_forget_one(items[i].nodeid, items[i].nlookup);
      return;  // no reply
    }
    case FUSE_GETATTR: return do_getattr(h, payload);
    case FUSE_SETATTR: return do_setattr(h, payload);
    case FUSE_READLINK: return do_readlink(h, payload);
    case FUSE_SYMLINK: return do_symlink(h, payload);
    case FUSE_MKNOD: return do_mknod(h, payload);
    case FUSE_MKDIR: return do_mkdir(h, payload);
    case FUSE_UNLINK: return do_unlink(h, payload, false);
    case FUSE_RMDIR: return do_unlink(h, payload, true);
    case FUSE_RENAME: return do_rename(h, payload, false);
    case FUSE_RENAME2: return do_rename(h, payload, true);
    case FUSE_LINK: return do_link(h, payload);
    case FUSE_OPEN: return do_open(h, payload);
    case FUSE_READ: return do_read(h, payload);
    case FUSE_WRITE: return do_write(h, payload);
    case FUSE_RELEASE: return do_release(h, payload);
    case FUSE_FLUSH: return do_flush(h, payload);
    case FUSE_FSYNC: return do_fsync(h, payload);
    case FUSE_FSYNCDIR: return reply_ok(h->unique, nullptr, 0);
    case FUSE_STATFS: return do_statfs(h);
    case FUSE_OPENDIR: return do_opendir(h, payload);
    case FUSE_READDIR: return do_readdir(h, payload);
    case FUSE_RELEASEDIR: return do_releasedir(h, payload);
    case FUSE_CREATE: return do_create(h, payload);
    case FUSE_ACCESS: return do_access(h, payload);
    case FUSE_FALLOCATE: return do_fallocate(h, payload);
    case FUSE_LSEEK: return do_lseek(h, payload);
    case FUSE_INTERRUPT: return;  // no reply for interrupt
    case FUSE_DESTROY:
      g_running = false;
      return reply_ok(h->unique, nullptr, 0);
    case FUSE_GETXATTR:
    case FUSE_SETXATTR:
    case FUSE_LISTXATTR:
    case FUSE_REMOVEXATTR:
    case FUSE_GETLK:
    case FUSE_SETLK:
    case FUSE_SETLKW:
    case FUSE_POLL:
    default:
      return reply_err(h->unique, ENOSYS);
  }
}

void unmount_and_exit(int) {
  if (!g_mountpoint.empty())
    umount2(g_mountpoint.c_str(), MNT_DETACH);
  _exit(0);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s <backing_dir> <mountpoint> [--foreground]\n",
            argv[0]);
    return 2;
  }
  const char* backing = argv[1];
  const char* mnt = argv[2];
  bool foreground = argc > 3 && !strcmp(argv[3], "--foreground");

  int root_fd = open(backing, O_PATH | O_DIRECTORY | O_CLOEXEC);
  if (root_fd < 0) {
    perror("open backing");
    return 1;
  }
  struct stat st;
  fstatat(root_fd, "", &st, AT_EMPTY_PATH);

  g_fuse_fd = open("/dev/fuse", O_RDWR | O_CLOEXEC);
  if (g_fuse_fd < 0) {
    perror("open /dev/fuse");
    return 1;
  }
  char opts[256];
  snprintf(opts, sizeof opts,
           "fd=%d,rootmode=%o,user_id=0,group_id=0,allow_other",
           g_fuse_fd, st.st_mode & S_IFMT);
  if (mount("faultfs", mnt, "fuse.faultfs", MS_NOSUID | MS_NODEV,
            opts) < 0) {
    perror("mount");
    return 1;
  }
  g_mountpoint = mnt;

  Inode root;
  root.path_fd = root_fd;
  root.nlookup = 1;
  root.name = "";
  root.dev = st.st_dev;
  root.ino = st.st_ino;
  g_inodes[FUSE_ROOT_ID] = root;
  g_by_devino[devino_key(st.st_dev, st.st_ino)] = FUSE_ROOT_ID;

  signal(SIGINT, unmount_and_exit);
  signal(SIGTERM, unmount_and_exit);

  if (!foreground) {
    if (fork() > 0) return 0;  // parent exits; child serves
    setsid();
    // Detach stdio: the child would otherwise hold the invoking
    // control-plane exec's pipes open forever (its subprocess.run
    // waits for pipe EOF, not just the parent's exit).
    int devnull = open("/dev/null", O_RDWR);
    if (devnull >= 0) {
      dup2(devnull, 0);
      dup2(devnull, 1);
      dup2(devnull, 2);
      if (devnull > 2) close(devnull);
    }
  }

  std::vector<char> buf((1 << 20) + 4096);
  while (g_running) {
    ssize_t n = read(g_fuse_fd, buf.data(), buf.size());
    if (n < 0) {
      if (errno == EINTR || errno == EAGAIN) continue;
      if (errno == ENODEV) break;  // unmounted
      break;
    }
    if ((size_t)n < sizeof(fuse_in_header)) continue;
    auto* h = reinterpret_cast<const fuse_in_header*>(buf.data());
    handle(h, buf.data() + sizeof(fuse_in_header));
  }
  umount2(mnt, MNT_DETACH);
  return 0;
}
