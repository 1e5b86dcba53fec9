// Native WebAssembly (MVP) interpreter for circom circuit binaries.
//
// Own copy of snarkjs_tpu/native/wasmvm.cpp; only its comments differ.
//
// The reference runs circuit .wasm through Node's native WASM VM
// (circom_runtime, reference src/wtns_calculate.js:27-50).  The package
// carries its own: the Python interpreter (snarkjs_tpu_torch/wasm/interp.py,
// `vm="python"`) defines the semantics; this C++ twin is the default
// (`vm="native"`, ~100x faster), held against the Python one by
// tests/test_torch_wasm.py.  Scope mirrors interp.py exactly: i32/i64
// numerics, linear memory, block/loop/if control, br_table, call_indirect,
// globals, active data/elem segments.  The circom runtime host imports
// (exceptionHandler, printErrorMessage, writeBufferMessage,
// showSharedRWMemory, circom1 error/log*) are built in; debug-logging
// hooks need the Python interpreter.
//
// C ABI at the bottom; built by g++ (snarkjs_tpu_torch/_build.py,
// host_library) and driven via ctypes from snarkjs_tpu_torch/wasm/native.py.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

struct Trap : std::runtime_error {
    explicit Trap(const std::string &m) : std::runtime_error(m) {}
};

static u64 leb_u(const u8 *d, size_t &p) {
    u64 res = 0; int shift = 0;
    for (;;) {
        u8 b = d[p++];
        res |= (u64)(b & 0x7F) << shift;
        if (!(b & 0x80)) return res;
        shift += 7;
    }
}

static int64_t leb_s(const u8 *d, size_t &p) {
    int64_t res = 0; int shift = 0; u8 b;
    do {
        b = d[p++];
        res |= (int64_t)(b & 0x7F) << shift;
        shift += 7;
    } while (b & 0x80);
    if (shift < 64 && (b & 0x40)) res |= -((int64_t)1 << shift);
    return res;
}

struct FuncType { std::vector<u8> params, results; };

struct Function {
    u32 type_idx;
    u32 n_locals;
    const u8 *body;
    size_t body_len;
};

struct Jump {            // control-flow pre-scan entry
    int kind;            // 0 = end-only, 1 = if/else
    size_t else_p;
    size_t end_p;
};

struct Module {
    std::vector<u8> data;
    std::vector<FuncType> types;
    struct Import { std::string mod, name; u32 type_idx; };
    std::vector<Import> imports;
    std::vector<u32> func_type_idx;
    std::vector<Function> funcs;
    size_t table_size = 0;
    u64 mem_pages = 0;
    struct GlobalInit { u8 mut_, vt; u64 val; };
    std::vector<GlobalInit> globals_init;
    std::map<std::string, std::pair<u8, u32>> exports;
    std::vector<std::pair<u64, std::pair<size_t, size_t>>> data_segments;
    std::vector<std::pair<u64, std::vector<u32>>> elem_segments;
    size_t n_imported = 0;

    u64 const_expr(size_t &p) {
        u8 op = data[p++];
        u64 v;
        if (op == 0x41) v = (u64)leb_s(data.data(), p);
        else if (op == 0x42) v = (u64)leb_s(data.data(), p);
        else if (op == 0x23) v = leb_u(data.data(), p);
        else throw Trap("unsupported const expr");
        if (data[p++] != 0x0B) throw Trap("const expr end expected");
        return v;
    }

    explicit Module(const u8 *bytes, size_t len) : data(bytes, bytes + len) {
        if (len < 8 || memcmp(bytes, "\0asm", 4) != 0)
            throw Trap("not a wasm module");
        const u8 *d = data.data();
        size_t pos = 8;
        while (pos < len) {
            u8 sec = d[pos++];
            u64 size = leb_u(d, pos);
            size_t end = pos + size;
            size_t p = pos;
            if (sec == 1) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    if (d[p++] != 0x60) throw Trap("bad functype");
                    FuncType ft;
                    u64 np = leb_u(d, p);
                    ft.params.assign(d + p, d + p + np); p += np;
                    u64 nr = leb_u(d, p);
                    ft.results.assign(d + p, d + p + nr); p += nr;
                    types.push_back(std::move(ft));
                }
            } else if (sec == 2) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    u64 ln = leb_u(d, p);
                    std::string mod((const char *)d + p, ln); p += ln;
                    ln = leb_u(d, p);
                    std::string name((const char *)d + p, ln); p += ln;
                    u8 kind = d[p++];
                    if (kind == 0) {
                        u32 ti = (u32)leb_u(d, p);
                        imports.push_back({mod, name, ti});
                        n_imported++;
                    } else if (kind == 2) {
                        u64 flags = leb_u(d, p);
                        u64 mn = leb_u(d, p);
                        if (flags & 1) leb_u(d, p);
                        if (mn > mem_pages) mem_pages = mn;
                    } else if (kind == 1) {
                        p += 1;
                        u64 flags = leb_u(d, p);
                        leb_u(d, p);
                        if (flags & 1) leb_u(d, p);
                    } else {
                        p += 2;
                    }
                }
            } else if (sec == 3) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++)
                    func_type_idx.push_back((u32)leb_u(d, p));
            } else if (sec == 4) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    p += 1;
                    u64 flags = leb_u(d, p);
                    u64 mn = leb_u(d, p);
                    if (flags & 1) leb_u(d, p);
                    table_size = (size_t)mn;
                }
            } else if (sec == 5) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    u64 flags = leb_u(d, p);
                    u64 mn = leb_u(d, p);
                    if (flags & 1) leb_u(d, p);
                    if (mn > mem_pages) mem_pages = mn;
                }
            } else if (sec == 6) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    u8 vt = d[p++];
                    u8 mut_ = d[p++];
                    u64 v = const_expr(p);
                    globals_init.push_back({mut_, vt, v});
                }
            } else if (sec == 7) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    u64 ln = leb_u(d, p);
                    std::string name((const char *)d + p, ln); p += ln;
                    u8 kind = d[p++];
                    u32 idx = (u32)leb_u(d, p);
                    exports[name] = {kind, idx};
                }
            } else if (sec == 9) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    u64 flags = leb_u(d, p);
                    if (flags != 0) throw Trap("passive elem");
                    u64 off = const_expr(p);
                    u64 n = leb_u(d, p);
                    std::vector<u32> idxs;
                    for (u64 j = 0; j < n; j++)
                        idxs.push_back((u32)leb_u(d, p));
                    elem_segments.push_back({off, std::move(idxs)});
                }
            } else if (sec == 10) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    u64 bsz = leb_u(d, p);
                    size_t bend = p + bsz;
                    u64 nloc_groups = leb_u(d, p);
                    u32 n_locals = 0;
                    for (u64 g = 0; g < nloc_groups; g++) {
                        u64 ncnt = leb_u(d, p);
                        p += 1;
                        n_locals += (u32)ncnt;
                    }
                    funcs.push_back({func_type_idx[i], n_locals,
                                     d + p, bend - p});
                    p = bend;
                }
            } else if (sec == 11) {
                u64 cnt = leb_u(d, p);
                for (u64 i = 0; i < cnt; i++) {
                    u64 flags = leb_u(d, p);
                    if (flags != 0) throw Trap("passive data");
                    u64 off = const_expr(p);
                    u64 n = leb_u(d, p);
                    data_segments.push_back({off, {p, (size_t)n}});
                    p += n;
                }
            }
            pos = end;
        }
    }
};

static inline int32_t s32(u64 v) { return (int32_t)(u32)v; }
static inline int64_t s64(u64 v) { return (int64_t)v; }

struct Instance {
    static const size_t PAGE = 65536;
    Module m;
    std::vector<u8> mem;
    size_t max_pages = 32768;
    std::vector<u64> globals;
    std::vector<int64_t> table;                    // -1 = uninitialized
    std::unordered_map<const u8 *, std::unordered_map<size_t, Jump>> jump_cache;
    // circom runtime message buffers
    std::string err_parts, msg_parts, last_error;
    int depth = 0;

    Instance(const u8 *bytes, size_t len) : m(bytes, len) {
        mem.resize(m.mem_pages * PAGE);
        // circom expects the host-supplied big imported memory
        if (m.mem_pages && mem.size() < ((size_t)1 << 28))
            mem.resize((size_t)1 << 28);
        for (auto &g : m.globals_init) globals.push_back(g.val);
        for (auto &seg : m.data_segments) {
            const u8 *src = m.data.data() + seg.second.first;
            memcpy(mem.data() + seg.first, src, seg.second.second);
        }
        table.assign(m.table_size, -1);
        for (auto &es : m.elem_segments)
            for (size_t i = 0; i < es.second.size(); i++)
                table[es.first + i] = es.second[i];
    }

    // ---- control-flow pre-scan (mirrors interp.py _jumps) ----
    const std::unordered_map<size_t, Jump> &jumps(const Function &f) {
        auto it = jump_cache.find(f.body);
        if (it != jump_cache.end()) return it->second;
        std::unordered_map<size_t, Jump> js;
        std::vector<std::pair<size_t, size_t>> stack;  // (start, else or ~0)
        const u8 *b = f.body;
        size_t p = 0, n = f.body_len;
        while (p < n) {
            u8 op = b[p];
            size_t q = p + 1;
            if (op == 0x02 || op == 0x03 || op == 0x04) {
                q += 1;  // blocktype
                stack.push_back({p, (size_t)-1});
            } else if (op == 0x05) {
                js[stack.back().first] = {1, p, 0};
                stack.back().second = p;
            } else if (op == 0x0B) {
                if (!stack.empty()) {
                    auto top = stack.back(); stack.pop_back();
                    if (top.second != (size_t)-1) {
                        js[top.first] = {1, top.second, p};
                        js[top.second] = {0, 0, p};
                    } else {
                        js[top.first] = {0, 0, p};
                    }
                }
            } else if (op == 0x0C || op == 0x0D) {
                leb_u(b, q);
            } else if (op == 0x0E) {
                u64 cnt = leb_u(b, q);
                for (u64 i = 0; i <= cnt; i++) leb_u(b, q);
            } else if (op == 0x10) {
                leb_u(b, q);
            } else if (op == 0x11) {
                leb_u(b, q); q += 1;
            } else if (op >= 0x20 && op <= 0x24) {
                leb_u(b, q);
            } else if (op >= 0x28 && op <= 0x3E) {
                leb_u(b, q); leb_u(b, q);
            } else if (op == 0x3F || op == 0x40) {
                q += 1;
            } else if (op == 0x41) {
                leb_s(b, q);
            } else if (op == 0x42) {
                leb_s(b, q);
            } else if (op == 0x43) {
                q += 4;
            } else if (op == 0x44) {
                q += 8;
            }
            p = q;
        }
        return jump_cache.emplace(f.body, std::move(js)).first->second;
    }

    // ---- exports ----
    bool has_export(const std::string &name) {
        auto it = m.exports.find(name);
        return it != m.exports.end() && it->second.first == 0;
    }

    bool invoke(const std::string &name, const std::vector<u64> &args,
                u64 &result) {
        auto it = m.exports.find(name);
        if (it == m.exports.end() || it->second.first != 0)
            throw Trap("no export " + name);
        return call(it->second.second, args, result);
    }

    // returns true if a result value was produced
    bool call(u32 fidx, const std::vector<u64> &args, u64 &result) {
        if (fidx < m.n_imported) return host_call(fidx, args, result);
        if (++depth > 20000) { depth--; throw Trap("call stack exhausted"); }
        const Function &f = m.funcs[fidx - m.n_imported];
        const FuncType &ft = m.types[f.type_idx];
        std::vector<u64> locals(args);
        locals.resize(args.size() + f.n_locals, 0);
        bool r = exec(f, ft, locals, result);
        depth--;
        return r;
    }

    // ---- circom runtime host imports ----
    std::string get_message() {
        std::string out;
        u64 c = 0;
        std::vector<u64> no_args;
        for (;;) {
            invoke("getMessageChar", no_args, c);
            if (!c) break;
            out.push_back((char)c);
        }
        return out;
    }

    bool host_call(u32 fidx, const std::vector<u64> &args, u64 &result) {
        const auto &imp = m.imports[fidx];
        const std::string &nm = imp.name;
        if (nm == "exceptionHandler") {
            static const char *errs[] = {
                "Unknown error. ", "Signal not found. ",
                "Too many signals set. ", "Signal already set. ",
                "Assert Failed. ", "Not enough memory. ",
                "Input signal array access exceeds the size. "};
            u64 code = args.empty() ? 0 : args[0];
            const char *base = (code >= 1 && code <= 6) ? errs[code]
                                                        : errs[0];
            throw Trap(std::string(base) + err_parts);
        } else if (nm == "printErrorMessage") {
            err_parts += get_message() + "\n";
        } else if (nm == "writeBufferMessage") {
            msg_parts += get_message();
        } else if (nm == "showSharedRWMemory" || nm == "printDebug" ||
                   nm == "log" || nm == "logGetSignal" ||
                   nm == "logSetSignal" || nm == "logStartComponent" ||
                   nm == "logFinishComponent") {
            // no-ops (debug hooks use the Python interpreter instead)
        } else if (nm == "error") {
            // circom1: error(code, pstr, a, b, c, d)
            u64 pstr = args.size() > 1 ? args[1] : 0;
            std::string msg;
            for (size_t i = pstr; i < mem.size() && mem[i]; i++)
                msg.push_back((char)mem[i]);
            char buf[256];
            snprintf(buf, sizeof buf, "circuit error %llu: %s",
                     (unsigned long long)(args.empty() ? 0 : args[0]),
                     msg.c_str());
            throw Trap(buf);
        } else {
            throw Trap("call to unresolved import " + imp.mod + "." + nm);
        }
        (void)result;
        return false;
    }

    // ---- interpreter core ----
    bool exec(const Function &f, const FuncType &ft, std::vector<u64> &locals,
              u64 &result) {
        const u8 *b = f.body;
        const size_t n = f.body_len;
        const auto &js = jumps(f);
        std::vector<u64> st;
        st.reserve(64);
        struct Ctrl { size_t start, end_p; bool is_loop; size_t depth_st; };
        std::vector<Ctrl> ctrl;
        size_t p = 0;

        auto mem_at = [&](u64 addr, size_t sz) -> u8 * {
            if (addr + sz > mem.size()) throw Trap("memory out of bounds");
            return mem.data() + addr;
        };
        auto do_branch = [&](u64 depth_) {
            const Ctrl &t = ctrl[ctrl.size() - 1 - depth_];
            Ctrl tc = t;
            ctrl.resize(ctrl.size() - depth_);
            if (tc.is_loop) {
                st.resize(tc.depth_st);
                p = tc.start + 2;
                return;
            }
            ctrl.pop_back();
            st.resize(tc.depth_st);
            p = tc.end_p + 1;
        };
        auto invoke_into = [&](u32 fi) {
            const FuncType *cft;
            if (fi < m.n_imported) cft = &m.types[m.imports[fi].type_idx];
            else cft = &m.types[m.funcs[fi - m.n_imported].type_idx];
            size_t na = cft->params.size();
            std::vector<u64> args(st.end() - na, st.end());
            st.resize(st.size() - na);
            u64 r = 0;
            bool has = call(fi, args, r);
            if (!cft->results.empty()) {
                if (!has) throw Trap("missing return value");
                st.push_back(cft->results[0] == 0x7F ? (u64)(u32)r : r);
            }
        };

        while (p < n) {
            u8 op = b[p++];
            switch (op) {
            case 0x0B:  // end
                if (!ctrl.empty()) { ctrl.pop_back(); continue; }
                p = n;
                break;
            case 0x02: case 0x03: {  // block / loop
                p += 1;
                const Jump &j = js.at(p - 2);
                ctrl.push_back({p - 2, j.end_p, op == 0x03, st.size()});
                break;
            }
            case 0x04: {  // if
                p += 1;
                size_t start = p - 2;
                const Jump &j = js.at(start);
                u64 cond = st.back(); st.pop_back();
                if (j.kind == 1) {
                    ctrl.push_back({start, j.end_p, false, st.size()});
                    if (!cond) p = j.else_p + 1;
                } else {
                    if (cond) ctrl.push_back({start, j.end_p, false,
                                              st.size()});
                    else p = j.end_p + 1;
                }
                break;
            }
            case 0x05: {  // else reached from then-branch: jump to end
                const Jump &j = js.at(p - 1);
                ctrl.pop_back();
                p = j.end_p + 1;
                break;
            }
            case 0x0C: {  // br
                u64 depth_ = leb_u(b, p);
                do_branch(depth_);
                break;
            }
            case 0x0D: {  // br_if
                u64 depth_ = leb_u(b, p);
                u64 c = st.back(); st.pop_back();
                if (c) do_branch(depth_);
                break;
            }
            case 0x0E: {  // br_table
                u64 cnt = leb_u(b, p);
                std::vector<u64> targets(cnt);
                for (u64 i = 0; i < cnt; i++) targets[i] = leb_u(b, p);
                u64 deflt = leb_u(b, p);
                u32 i = (u32)st.back(); st.pop_back();
                do_branch(i < cnt ? targets[i] : deflt);
                break;
            }
            case 0x0F:  // return
                if (!ft.results.empty()) {
                    result = st.back();
                    return true;
                }
                return false;
            case 0x00: throw Trap("unreachable");
            case 0x01: break;  // nop
            case 0x10: {  // call
                u32 fi = (u32)leb_u(b, p);
                invoke_into(fi);
                break;
            }
            case 0x11: {  // call_indirect
                leb_u(b, p); p += 1;
                u32 elem = (u32)st.back(); st.pop_back();
                if (elem >= table.size() || table[elem] < 0)
                    throw Trap("uninitialized table element");
                invoke_into((u32)table[elem]);
                break;
            }
            case 0x1A: st.pop_back(); break;  // drop
            case 0x1B: {  // select
                u64 c = st.back(); st.pop_back();
                u64 bb = st.back(); st.pop_back();
                u64 a = st.back(); st.pop_back();
                st.push_back(c ? a : bb);
                break;
            }
            case 0x20: st.push_back(locals[leb_u(b, p)]); break;
            case 0x21: { u64 i = leb_u(b, p); locals[i] = st.back();
                         st.pop_back(); break; }
            case 0x22: { u64 i = leb_u(b, p); locals[i] = st.back(); break; }
            case 0x23: st.push_back(globals[leb_u(b, p)]); break;
            case 0x24: { u64 i = leb_u(b, p); globals[i] = st.back();
                         st.pop_back(); break; }
            // ---- loads ----
            case 0x28: case 0x29: case 0x2C: case 0x2D: case 0x2E:
            case 0x2F: case 0x30: case 0x31: case 0x32: case 0x33:
            case 0x34: case 0x35: {
                leb_u(b, p);
                u64 off = leb_u(b, p);
                u64 addr = (u32)st.back() + off; st.pop_back();
                u64 v;
                switch (op) {
                case 0x28: { u32 x; memcpy(&x, mem_at(addr, 4), 4); v = x;
                             break; }
                case 0x29: { memcpy(&v, mem_at(addr, 8), 8); break; }
                case 0x2C: v = (u64)(u32)(int32_t)(int8_t)*mem_at(addr, 1);
                           break;
                case 0x2D: v = *mem_at(addr, 1); break;
                case 0x2E: { int16_t x; memcpy(&x, mem_at(addr, 2), 2);
                             v = (u64)(u32)(int32_t)x; break; }
                case 0x2F: { uint16_t x; memcpy(&x, mem_at(addr, 2), 2);
                             v = x; break; }
                case 0x30: v = (u64)(int64_t)(int8_t)*mem_at(addr, 1); break;
                case 0x31: v = *mem_at(addr, 1); break;
                case 0x32: { int16_t x; memcpy(&x, mem_at(addr, 2), 2);
                             v = (u64)(int64_t)x; break; }
                case 0x33: { uint16_t x; memcpy(&x, mem_at(addr, 2), 2);
                             v = x; break; }
                case 0x34: { int32_t x; memcpy(&x, mem_at(addr, 4), 4);
                             v = (u64)(int64_t)x; break; }
                default:   { u32 x; memcpy(&x, mem_at(addr, 4), 4); v = x;
                             break; }
                }
                st.push_back(v);
                break;
            }
            // ---- stores ----
            case 0x36: case 0x37: case 0x3A: case 0x3B: case 0x3C:
            case 0x3D: case 0x3E: {
                leb_u(b, p);
                u64 off = leb_u(b, p);
                u64 v = st.back(); st.pop_back();
                u64 addr = (u32)st.back() + off; st.pop_back();
                switch (op) {
                case 0x36: { u32 x = (u32)v; memcpy(mem_at(addr, 4), &x, 4);
                             break; }
                case 0x37: memcpy(mem_at(addr, 8), &v, 8); break;
                case 0x3A: case 0x3C: *mem_at(addr, 1) = (u8)v; break;
                case 0x3B: case 0x3D: { uint16_t x = (uint16_t)v;
                             memcpy(mem_at(addr, 2), &x, 2); break; }
                default:   { u32 x = (u32)v; memcpy(mem_at(addr, 4), &x, 4);
                             break; }
                }
                break;
            }
            case 0x3F: p += 1; st.push_back(mem.size() / PAGE); break;
            case 0x40: {  // memory.grow
                p += 1;
                u64 delta = (u32)st.back(); st.pop_back();
                size_t cur = mem.size() / PAGE;
                if (cur + delta > max_pages) st.push_back(0xFFFFFFFFull);
                else {
                    mem.resize(mem.size() + delta * PAGE, 0);
                    st.push_back(cur);
                }
                break;
            }
            case 0x41: st.push_back((u64)(u32)(int32_t)leb_s(b, p)); break;
            case 0x42: st.push_back((u64)leb_s(b, p)); break;
            case 0x45: { u64 a = st.back(); st.pop_back();
                         st.push_back((u32)a == 0); break; }
            case 0x46: case 0x47: case 0x48: case 0x49: case 0x4A:
            case 0x4B: case 0x4C: case 0x4D: case 0x4E: case 0x4F: {
                u32 bb = (u32)st.back(); st.pop_back();
                u32 a = (u32)st.back(); st.pop_back();
                int32_t sa = (int32_t)a, sb = (int32_t)bb;
                bool v;
                switch (op) {
                case 0x46: v = a == bb; break;
                case 0x47: v = a != bb; break;
                case 0x48: v = sa < sb; break;
                case 0x49: v = a < bb; break;
                case 0x4A: v = sa > sb; break;
                case 0x4B: v = a > bb; break;
                case 0x4C: v = sa <= sb; break;
                case 0x4D: v = a <= bb; break;
                case 0x4E: v = sa >= sb; break;
                default:   v = a >= bb; break;
                }
                st.push_back(v ? 1 : 0);
                break;
            }
            case 0x50: { u64 a = st.back(); st.pop_back();
                         st.push_back(a == 0); break; }
            case 0x51: case 0x52: case 0x53: case 0x54: case 0x55:
            case 0x56: case 0x57: case 0x58: case 0x59: case 0x5A: {
                u64 bb = st.back(); st.pop_back();
                u64 a = st.back(); st.pop_back();
                int64_t sa = (int64_t)a, sb = (int64_t)bb;
                bool v;
                switch (op) {
                case 0x51: v = a == bb; break;
                case 0x52: v = a != bb; break;
                case 0x53: v = sa < sb; break;
                case 0x54: v = a < bb; break;
                case 0x55: v = sa > sb; break;
                case 0x56: v = a > bb; break;
                case 0x57: v = sa <= sb; break;
                case 0x58: v = a <= bb; break;
                case 0x59: v = sa >= sb; break;
                default:   v = a >= bb; break;
                }
                st.push_back(v ? 1 : 0);
                break;
            }
            // ---- i32 arithmetic ----
            case 0x67: { u32 a = (u32)st.back(); st.pop_back();
                st.push_back(a ? __builtin_clz(a) : 32); break; }
            case 0x68: { u32 a = (u32)st.back(); st.pop_back();
                st.push_back(a ? __builtin_ctz(a) : 32); break; }
            case 0x69: { u32 a = (u32)st.back(); st.pop_back();
                st.push_back(__builtin_popcount(a)); break; }
            case 0x6A: case 0x6B: case 0x6C: case 0x6D: case 0x6E:
            case 0x6F: case 0x70: case 0x71: case 0x72: case 0x73:
            case 0x74: case 0x75: case 0x76: case 0x77: case 0x78: {
                u32 bb = (u32)st.back(); st.pop_back();
                u32 a = (u32)st.back(); st.pop_back();
                u32 v;
                switch (op) {
                case 0x6A: v = a + bb; break;
                case 0x6B: v = a - bb; break;
                case 0x6C: v = a * bb; break;
                case 0x6D: {
                    if (!bb) throw Trap("div by zero");
                    if (a == 0x80000000u && bb == 0xFFFFFFFFu)
                        throw Trap("integer overflow");
                    v = (u32)((int32_t)a / (int32_t)bb); break; }
                case 0x6E: if (!bb) throw Trap("div by zero");
                           v = a / bb; break;
                case 0x6F: {
                    if (!bb) throw Trap("rem by zero");
                    if (a == 0x80000000u && bb == 0xFFFFFFFFu) { v = 0;
                        break; }
                    v = (u32)((int32_t)a % (int32_t)bb); break; }
                case 0x70: if (!bb) throw Trap("rem by zero");
                           v = a % bb; break;
                case 0x71: v = a & bb; break;
                case 0x72: v = a | bb; break;
                case 0x73: v = a ^ bb; break;
                case 0x74: v = a << (bb & 31); break;
                case 0x75: v = (u32)((int32_t)a >> (bb & 31)); break;
                case 0x76: v = a >> (bb & 31); break;
                case 0x77: { u32 r = bb & 31;
                    v = r ? ((a << r) | (a >> (32 - r))) : a; break; }
                default:   { u32 r = bb & 31;
                    v = r ? ((a >> r) | (a << (32 - r))) : a; break; }
                }
                st.push_back(v);
                break;
            }
            // ---- i64 arithmetic ----
            case 0x79: { u64 a = st.back(); st.pop_back();
                st.push_back(a ? __builtin_clzll(a) : 64); break; }
            case 0x7A: { u64 a = st.back(); st.pop_back();
                st.push_back(a ? __builtin_ctzll(a) : 64); break; }
            case 0x7B: { u64 a = st.back(); st.pop_back();
                st.push_back(__builtin_popcountll(a)); break; }
            case 0x7C: case 0x7D: case 0x7E: case 0x7F: case 0x80:
            case 0x81: case 0x82: case 0x83: case 0x84: case 0x85:
            case 0x86: case 0x87: case 0x88: case 0x89: case 0x8A: {
                u64 bb = st.back(); st.pop_back();
                u64 a = st.back(); st.pop_back();
                u64 v;
                switch (op) {
                case 0x7C: v = a + bb; break;
                case 0x7D: v = a - bb; break;
                case 0x7E: v = a * bb; break;
                case 0x7F: {
                    if (!bb) throw Trap("div by zero");
                    if (a == 0x8000000000000000ull && bb == ~0ull)
                        throw Trap("integer overflow");
                    v = (u64)((int64_t)a / (int64_t)bb); break; }
                case 0x80: if (!bb) throw Trap("div by zero");
                           v = a / bb; break;
                case 0x81: {
                    if (!bb) throw Trap("rem by zero");
                    if (a == 0x8000000000000000ull && bb == ~0ull) { v = 0;
                        break; }
                    v = (u64)((int64_t)a % (int64_t)bb); break; }
                case 0x82: if (!bb) throw Trap("rem by zero");
                           v = a % bb; break;
                case 0x83: v = a & bb; break;
                case 0x84: v = a | bb; break;
                case 0x85: v = a ^ bb; break;
                case 0x86: v = a << (bb & 63); break;
                case 0x87: v = (u64)((int64_t)a >> (bb & 63)); break;
                case 0x88: v = a >> (bb & 63); break;
                case 0x89: { u64 r = bb & 63;
                    v = r ? ((a << r) | (a >> (64 - r))) : a; break; }
                default:   { u64 r = bb & 63;
                    v = r ? ((a >> r) | (a << (64 - r))) : a; break; }
                }
                st.push_back(v);
                break;
            }
            case 0xA7: { u64 a = st.back(); st.pop_back();
                st.push_back((u32)a); break; }
            case 0xAC: { u64 a = st.back(); st.pop_back();
                st.push_back((u64)(int64_t)(int32_t)(u32)a); break; }
            case 0xAD: { u64 a = st.back(); st.pop_back();
                st.push_back((u32)a); break; }
            default: {
                char buf[64];
                snprintf(buf, sizeof buf, "unsupported opcode 0x%02x", op);
                throw Trap(buf);
            }
            }
        }
        if (!ft.results.empty() && !st.empty()) {
            result = st.back();
            return true;
        }
        return false;
    }
};

}  // namespace

extern "C" {

void *wvm_new(const u8 *data, u64 len, char *errbuf, u64 errcap) {
    try {
        return new Instance(data, (size_t)len);
    } catch (const std::exception &e) {
        if (errbuf && errcap) {
            strncpy(errbuf, e.what(), errcap - 1);
            errbuf[errcap - 1] = 0;
        }
        return nullptr;
    }
}

void wvm_free(void *h) { delete (Instance *)h; }

const char *wvm_error(void *h) {
    return ((Instance *)h)->last_error.c_str();
}

int wvm_invoke(void *h, const char *name, const u64 *args, int nargs,
               u64 *result, int *has_result) {
    Instance *inst = (Instance *)h;
    try {
        std::vector<u64> a(args, args + nargs);
        u64 r = 0;
        bool has = inst->invoke(name, a, r);
        *result = r;
        *has_result = has ? 1 : 0;
        return 0;
    } catch (const std::exception &e) {
        inst->last_error = e.what();
        return 1;
    }
}

int wvm_has_export(void *h, const char *name) {
    return ((Instance *)h)->has_export(name) ? 1 : 0;
}

u8 *wvm_mem(void *h, u64 *size) {
    Instance *inst = (Instance *)h;
    *size = inst->mem.size();
    return inst->mem.data();
}

}  // extern "C"
